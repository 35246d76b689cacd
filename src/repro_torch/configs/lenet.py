"""LeNet-300-100 on (synthetic) MNIST: the paper's own experiment model."""
from repro_torch.config import FLConfig, ModelConfig

CONFIG = ModelConfig(
    name="lenet-300-100", family="mlp",
    num_layers=2, d_model=300, num_heads=0, num_kv_heads=0,
    d_ff=100, vocab_size=10,
    source="paper §IV (LeCun & Cortes 1998 MNIST; 266,610 params)",
)

SMOKE = CONFIG

FL = FLConfig()
