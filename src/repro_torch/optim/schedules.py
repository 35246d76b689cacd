"""Learning-rate schedules (callables of the step counter): the port of
``repro/optim/schedules.py``.

A schedule takes the optimizer's step (an int32 tensor, or a Python int)
and returns the rate as a 0-d float32 tensor, computed in float32 as the
reference's jnp schedules compute it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_PI = float(np.float32(math.pi))    # jnp.pi enters a float32 product


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=torch.as_tensor(step).device)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        s = _f32(step)
        frac = torch.clamp(s / torch.full_like(s, max(total_steps, 1)),
                           0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(_PI * frac))
        return float(np.float32(lr)) * (final_frac + (1.0 - final_frac) * cos)

    return fn


def linear_warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_decay(lr, max(total_steps - warmup_steps, 1), final_frac)

    def fn(step):
        step = torch.as_tensor(step)
        s = step.to(torch.float32)
        warm = float(np.float32(lr)) * s / torch.full_like(
            s, max(warmup_steps, 1))
        return torch.where(s < warmup_steps, warm, cos(step - warmup_steps))

    return fn
