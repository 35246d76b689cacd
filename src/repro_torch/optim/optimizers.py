"""Optimizers over parameter trees (``(init, update_)`` pairs): the port
of ``repro/optim/optimizers.py``.

``update_(grads, state, params)`` updates in place: each parameter and
state leaf is overwritten leaf by leaf (the reference's jitted step under
``donate_argnums=(0, 1)``), so no second copy of them exists, and the trees
passed in come back as ``(params, state)``.  ``update`` is the same update
on copies, for callers that keep the old values.  The learning rate is a
float or a schedule ``fn(step)`` (:mod:`repro_torch.optim.schedules`).
Parameters, gradients and states are nested dicts of tensors (states hold
an int32 ``step`` and float32 moments), so they checkpoint like
parameters.  Each update is the reference's formula in its own float32 op
order, written out rather than taken from ``torch.optim``, whose AdamW
decays the weights before the step and adds ``eps`` elsewhere.
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
    # (grads, state, params) -> (params, state): the trees passed in, their
    # leaves overwritten (a state's step replaced in its dict)
    update_: Callable[[Any, Any, Any], tuple]

    def update(self, grads, state, params):
        """:attr:`update_` on copies of ``state`` and ``params``:
        ``(new_params, new_state)``, the trees passed in left as they
        are."""
        return self.update_(tree_lib.tree_map(lambda g: g, grads),
                            tree_lib.tree_map(torch.clone, state),
                            tree_lib.tree_map(torch.clone, params))


def _leaves(*trees):
    return zip(*(tree_lib.tree_flatten(t)[0] for t in trees))


def sgd(lr: Schedule) -> Optimizer:
    def init(params):
        return {"step": _step0(params)}

    def update_(grads, state, params):
        step = state["step"]
        eta = _lr_at(lr, step)
        for p, g in _leaves(params, grads):
            p.sub_(eta * g.to(p.dtype))
        state["step"] = step + 1
        return params, state

    return Optimizer(init, update_)


def momentum(lr: Schedule, beta: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"step": _step0(params),
                "mu": tree_lib.tree_map(torch.zeros_like, params)}

    def update_(grads, state, params):
        step = state["step"]
        eta = _lr_at(lr, step)
        b = float(np.float32(beta))
        for p, g, m in _leaves(params, grads, state["mu"]):
            m.mul_(b).add_(g.to(m.dtype))
            upd = b * m + g.to(m.dtype) if nesterov else m
            p.sub_(eta * upd.to(p.dtype))
        state["step"] = step + 1
        return params, state

    return Optimizer(init, update_)


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

    def update_(grads, state, params):
        # the reference's expressions, each product, quotient and sum
        # rounded on its own (no fused multiply-add), at most two leaf-sized
        # temporaries at a time: m = b1 * m + c1 * g, v = b2 * v + c2 * g^2,
        # p = p - eta * ((m / bc1) / (sqrt(v / bc2) + eps) + wd * p)
        step = state["step"] + 1
        eta = _lr_at(lr, step - 1)
        sf = step.to(f32)
        bc1 = 1 - torch.pow(torch.full_like(sf, b1_), sf)
        bc2 = 1 - torch.pow(torch.full_like(sf, b2_), sf)
        for p, g, m_, v_ in _leaves(params, grads, state["m"], state["v"]):
            g = g.to(f32)
            m_.mul_(b1_).add_(g * c1)
            v_.mul_(b2_).add_(torch.square(g).mul_(c2))
            upd = torch.div(m_, bc1).div_(
                torch.div(v_, bc2).sqrt_().add_(eps_))
            if weight_decay:
                upd.add_(p.to(f32) * wd)
            upd.mul_(eta)
            if p.dtype == f32:
                p.sub_(upd)
            else:
                p.copy_(p.to(f32).sub_(upd))
        state["step"] = step
        return params, state

    return Optimizer(init, update_)


def adam(lr: Schedule, b1=0.9, b2=0.999, eps=1e-8) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay=0.0)


def adamw(lr: Schedule, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.1) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay=weight_decay)
