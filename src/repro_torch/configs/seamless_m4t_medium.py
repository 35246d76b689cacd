"""SeamlessM4T-medium backbone: enc-dec transformer [arXiv:2308.11596].

Card lists the 12L multimodal backbone; we instantiate 12 encoder + 12
decoder layers. The codec/mel frontend is a stub per the assignment
carve-out: input_specs() supplies frame embeddings (B, S_enc, d_model).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206, head_dim=64,
    encoder_layers=12,
    source="arXiv:2308.11596",
)

SMOKE = ModelConfig(
    name="seamless-smoke", family="encdec",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
    d_ff=512, vocab_size=512, head_dim=64,
    encoder_layers=2,
    source="reduced seamless family",
)
