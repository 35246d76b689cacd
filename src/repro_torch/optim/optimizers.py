"""Optimizers over parameter trees (``(init, update)`` pairs): the port of
``repro/optim/optimizers.py``.

``update(grads, state, params)`` returns ``(new_params, new_state)``; the
learning rate is a float or a schedule ``fn(step)``
(:mod:`repro_torch.optim.schedules`).  Parameters, gradients and states are
nested dicts of tensors (states hold an int32 ``step`` and float32
moments), so they checkpoint like parameters.  Each update is the
reference's formula in its own float32 op order, written out rather than
taken from ``torch.optim``, whose AdamW decays the weights before the step
and adds ``eps`` elsewhere.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import numpy as np
import torch

from repro_torch.core import tree as tree_lib

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def _lr_at(lr: Schedule, step: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(step)
    return torch.tensor(lr, dtype=torch.float32, device=step.device)


def _first_device(params):
    leaves, _ = tree_lib.tree_flatten(params)
    return leaves[0].device if leaves else torch.device("cpu")


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_first_device(params))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]  # (grads, state, params)


def sgd(lr: Schedule) -> Optimizer:
    def init(params):
        return {"step": _step0(params)}

    def update(grads, state, params):
        step = state["step"]
        eta = _lr_at(lr, step)
        new = tree_lib.tree_map(lambda p, g: p - eta * g.to(p.dtype),
                                params, grads)
        return new, {"step": step + 1}

    return Optimizer(init, update)


def momentum(lr: Schedule, beta: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"step": _step0(params),
                "mu": tree_lib.tree_map(torch.zeros_like, params)}

    def update(grads, state, params):
        step, mu = state["step"], state["mu"]
        eta = _lr_at(lr, step)
        b = float(np.float32(beta))
        mu = tree_lib.tree_map(lambda m, g: b * m + g.to(m.dtype), mu, grads)
        if nesterov:
            upd = tree_lib.tree_map(lambda m, g: b * m + g.to(m.dtype),
                                    mu, grads)
        else:
            upd = mu
        new = tree_lib.tree_map(lambda p, u: p - eta * u.to(p.dtype),
                                params, upd)
        return new, {"step": step + 1, "mu": mu}

    return Optimizer(init, update)


def _adam_core(lr, b1, b2, eps, weight_decay):
    f32 = torch.float32
    # the Python constants enter the reference's float32 ops rounded
    b1_, b2_ = float(np.float32(b1)), float(np.float32(b2))
    c1, c2 = float(np.float32(1 - b1)), float(np.float32(1 - b2))
    eps_, wd = float(np.float32(eps)), float(np.float32(weight_decay))

    def init(params):
        z = tree_lib.tree_map(lambda p: torch.zeros_like(p, dtype=f32),
                              params)
        return {"step": _step0(params), "m": z,
                "v": tree_lib.tree_map(torch.zeros_like, z)}

    def update(grads, state, params):
        step = state["step"] + 1
        eta = _lr_at(lr, step - 1)
        m = tree_lib.tree_map(lambda m_, g: b1_ * m_ + c1 * g.to(f32),
                              state["m"], grads)
        v = tree_lib.tree_map(
            lambda v_, g: b2_ * v_ + c2 * torch.square(g.to(f32)),
            state["v"], grads)
        sf = step.to(f32)
        bc1 = 1 - torch.pow(torch.full_like(sf, b1_), sf)
        bc2 = 1 - torch.pow(torch.full_like(sf, b2_), sf)

        def step_fn(p, m_, v_):
            upd = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps_)
            if weight_decay:
                upd = upd + wd * p.to(f32)
            return (p.to(f32) - eta * upd).to(p.dtype)

        new = tree_lib.tree_map(step_fn, params, m, v)
        return new, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def adam(lr: Schedule, b1=0.9, b2=0.999, eps=1e-8) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay=0.0)


def adamw(lr: Schedule, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.1) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay=weight_decay)
