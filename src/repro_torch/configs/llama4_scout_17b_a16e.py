"""Llama-4-Scout-17B-16E: MoE 16 experts top-1 + shared expert, block-local
attention for long context (iRoPE-style chunking)
[hf:meta-llama/Llama-4-Scout-17B-16E]. Early-fusion multimodality is out of
backbone scope (token inputs only; DESIGN.md §4)."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    num_experts=16, experts_per_token=1, moe_shared_expert=True,
    attention_chunk=8192, rope_theta=500_000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

SMOKE = ModelConfig(
    name="llama4-smoke", family="moe",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512, head_dim=64,
    num_experts=4, experts_per_token=1, moe_shared_expert=True,
    attention_chunk=64,
    source="reduced llama4 family",
)
