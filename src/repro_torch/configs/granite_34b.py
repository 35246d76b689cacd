"""Granite-34B-Code: llama-arch dense with MQA (kv=1) [arXiv:2405.04324]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
    source="arXiv:2405.04324",
)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=1,
    d_ff=512, vocab_size=512, head_dim=64,
    source="reduced granite family",
)
