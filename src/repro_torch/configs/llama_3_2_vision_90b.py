"""Llama-3.2-Vision-90B backbone: cross-attn image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision]. Vision tower is a stub: img_feats
arrive pre-projected (B, num_image_tokens, d_model)."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256, head_dim=128,
    cross_attn_every=5, num_image_tokens=1600, rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)

SMOKE = ModelConfig(
    name="llama-vision-smoke", family="vlm",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512, head_dim=64,
    cross_attn_every=2, num_image_tokens=16,
    source="reduced llama-3.2-vision family",
)
