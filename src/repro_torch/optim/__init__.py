from repro_torch.optim.optimizers import (
    Optimizer,
    adam,
    adamw,
    momentum,
    sgd,
)
from repro_torch.optim.schedules import (
    constant, cosine_decay, linear_warmup_cosine,
)
