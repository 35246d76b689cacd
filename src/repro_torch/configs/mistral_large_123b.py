"""Mistral-Large-2407 (123B): dense GQA
[hf:mistralai/Mistral-Large-Instruct-2407]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=28672, vocab_size=32768, head_dim=128,
    rope_theta=1_000_000.0,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)

SMOKE = ModelConfig(
    name="mistral-large-smoke", family="dense",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512, head_dim=64,
    source="reduced mistral-large family",
)
