"""Parameter initialization from a ``torch.Generator``.

The reference's rule for LeNet: weights are a truncated normal on [-3, 3]
scaled by the fan-in standard deviation 1 / sqrt(fan_in), biases are zero.
The draws come from a seeded CPU generator, so one seed gives the same
weights whichever device the run trains on; they differ from the
reference's ``jax.random`` draws (inject those through
``convert.params_from_jax`` where both packages must start alike).
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.models import lenet


def init_lenet(seed: int, *, device=None):
    """Fresh LeNet parameters (nested dict of float32 tensors) on ``device``
    (``None`` means ``cuda``, which raises without CUDA: pass ``"cpu"``)."""
    device = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    params = {}
    for name, fan_in, fan_out in lenet.LAYERS:
        w = torch.empty(fan_in, fan_out, dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
        params[name] = {
            "w": (w * (1.0 / math.sqrt(fan_in))).to(device),
            "b": torch.zeros(fan_out, dtype=torch.float32, device=device),
        }
    return params
