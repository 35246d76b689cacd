"""Step functions (train / serve): the port of ``repro/launch/steps.py``
(the prefill step and the input specs wait for ``launch/dryrun.py``,
ROADMAP.md item 8d).

The FL-NOMA integration at LLM scale: :func:`make_train_step` puts the
paper's DoReFa quantize -> dequantize on the gradient tree between the
backward pass and the optimizer (the uplink of Algorithm 1), with the
bit width ``fl_bits`` given per round by the NOMA rate model.

The reference jits its steps with a static width; XLA then rounds the
quantizer as ``kernels/ref.py``'s jitted form, and this step calls
:func:`repro_torch.core.compression.encode_decode_tree` (the eager form),
which agrees with it within 2 ulp (``ROADMAP.md`` queue 3, "DoReFa, jitted
against eager").  The reference's ``remat`` (``jax.checkpoint``) and
``unroll`` only steer XLA and have no counterpart here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import compression
from repro_torch.core import tree as tree_lib
from repro_torch.models.registry import Model


def _value_and_grad(model: Model, params, batch, kv_chunk: int):
    """(loss, grads) of ``model.loss`` at ``params`` (a tree of float32
    leaves); the gradients come back as a tree of the same structure."""
    leaves, treedef = tree_lib.tree_flatten(params)
    req = [w.detach().requires_grad_(True) for w in leaves]
    loss = model.loss(tree_lib.tree_unflatten(treedef, req), batch,
                      kv_chunk=kv_chunk)
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(w) if g is None else g
             for w, g in zip(req, grads)]
    return loss.detach(), tree_lib.tree_unflatten(treedef, grads)


def make_train_step(model: Model, optimizer, *, fl_bits: Optional[int] = None,
                    kv_chunk: int = 1024, grad_accum: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, loss).

    ``grad_accum > 1`` splits the global batch into interleaved
    microbatches (row i goes to microbatch i % grad_accum, as the
    reference's reshape and swap lay them out) and sums their gradients in
    float32; the round's gradient is the mean, and the paper's
    quantization applies to it (one uplink per round)."""

    def train_step(params, opt_state, batch):
        if grad_accum > 1:
            def split(x):
                mb = x.shape[0] // grad_accum
                return x.reshape(mb, grad_accum, *x.shape[1:]).transpose(0, 1)

            micro = {k: split(v) for k, v in batch.items()}
            gsum = tree_lib.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            lsum = None
            for i in range(grad_accum):
                loss, g = _value_and_grad(
                    model, params, {k: v[i] for k, v in micro.items()},
                    kv_chunk)
                gsum = tree_lib.tree_map(
                    lambda a, b_: a + b_.to(torch.float32), gsum, g)
                lsum = loss.to(torch.float32) if lsum is None else lsum + loss
            div = torch.full_like(lsum, grad_accum)
            grads = tree_lib.tree_map(lambda g: g / div, gsum)
            loss = lsum / div
        else:
            loss, grads = _value_and_grad(model, params, batch, kv_chunk)
        if fl_bits is not None and fl_bits < 32:
            grads = compression.encode_decode_tree(grads, fl_bits)
        with torch.no_grad():
            new_params, new_state = optimizer.update(grads, opt_state, params)
        return new_params, new_state, loss

    return train_step


def make_serve_step(model: Model, *, kv_chunk: int = 4096):
    """(params, caches, batch) -> (next token (B, 1) int32, caches):
    greedy decode over the first ``vocab_size`` logits."""

    def serve_step(params, caches, batch):
        with torch.no_grad():
            logits, new_caches = model.decode_step(
                params, caches, batch["tokens"], batch=batch,
                kv_chunk=kv_chunk)
        nxt = torch.argmax(logits[:, -1, : model.cfg.vocab_size], dim=-1)
        return nxt.to(torch.int32)[:, None], new_caches

    return serve_step
