"""Step functions (train / prefill / serve) and their input specs: the
port of ``repro/launch/steps.py``.

The FL-NOMA integration at LLM scale: :func:`make_train_step` puts the
paper's DoReFa quantize -> dequantize on the gradient tree between the
backward pass and the optimizer (the uplink of Algorithm 1), with the
bit width ``fl_bits`` given per round by the NOMA rate model.

The reference jits its steps with a static width, and XLA compiles what
they compute in another op order than the source text: the quantizer as
``c * (s * fl(1/a))`` and the mean of ``grad_accum`` microbatches as a
product with ``fl(1/grad_accum)``.  This module computes both in that
order (:func:`repro_torch.core.compression.quantize_dequantize_tree`, on
the card kernel #5, one launch per leaf).  The reference's ``remat``
(``jax.checkpoint``) and ``unroll`` only steer XLA and have no counterpart
here.

:func:`input_specs` and :func:`abstract_cache` are the dry-run's stand-ins
(``launch/dryrun.py``): fake tensors, which carry shapes and dtypes and
allocate nothing.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.core import compression
from repro_torch.core import tree as tree_lib
from repro_torch.models.registry import Model


# --------------------------------------------------------------------------
# Abstract inputs (dry-run stand-ins; no allocation)
# --------------------------------------------------------------------------

def enc_frames(shape: ShapeConfig) -> int:
    """Stub audio frontend length: 4 tokens per frame."""
    return max(shape.seq_len // 4, 64)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                fake_mode: Optional[FakeTensorMode] = None):
    """Fake CPU tensors standing in for every model input of this shape
    (the reference's ``ShapeDtypeStruct`` tree), made under ``fake_mode``
    (a new one by default)."""
    b, s = shape.global_batch, shape.seq_len
    feats = {"vlm": ("img_feats", cfg.num_image_tokens),
             "encdec": ("enc_out" if shape.kind == "decode" else "enc_feats",
                        enc_frames(shape))}
    with fake_mode or FakeTensorMode():
        if shape.kind == "train":
            batch = {"tokens": torch.empty((b, s), dtype=torch.int32),
                     "labels": torch.empty((b, s), dtype=torch.int32)}
        elif shape.kind == "prefill":
            batch = {"tokens": torch.empty((b, s), dtype=torch.int32)}
        else:       # decode: one new token against a seq_len-deep cache
            batch = {"tokens": torch.empty((b, 1), dtype=torch.int32)}
        if cfg.family in feats:
            name, n = feats[cfg.family]
            batch[name] = torch.empty((b, n, cfg.d_model),
                                      dtype=torch.bfloat16)
    return batch


def abstract_cache(model: Model, shape: ShapeConfig, *,
                   fake_mode: Optional[FakeTensorMode] = None):
    """The decode caches of ``shape`` (``global_batch`` rows, ``seq_len``
    deep) as fake CPU tensors made under ``fake_mode``."""
    with fake_mode or FakeTensorMode():
        return model.init_cache(shape.global_batch, shape.seq_len,
                                device="cpu")


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
    quantization applies to it (one uplink per round).  The mean is a
    product with ``fl(1/grad_accum)``, as XLA compiles the reference's
    division by a constant."""
    inv_accum = float(np.float32(1.0) / np.float32(grad_accum))

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
            grads = tree_lib.tree_map(lambda g: g * inv_accum, gsum)
            loss = lsum * inv_accum
        else:
            loss, grads = _value_and_grad(model, params, batch, kv_chunk)
        if fl_bits is not None and fl_bits < 32:
            grads = compression.quantize_dequantize_tree(grads, fl_bits)
        with torch.no_grad():
            new_params, new_state = optimizer.update(grads, opt_state, params)
        return new_params, new_state, loss

    return train_step


def make_prefill_step(model: Model, shape: ShapeConfig, *,
                      kv_chunk: int = 1024, device=None):
    """(params, batch) -> (last logits (B, 1, V), caches): the prompt's
    forward into fresh caches of ``shape`` on ``device`` (``None`` means
    ``cuda``, which raises without CUDA: pass ``"cpu"``)."""

    def prefill_step(params, batch):
        caches = model.init_cache(shape.global_batch, shape.seq_len,
                                  device=device)
        with torch.no_grad():
            out = model.forward(params, batch, caches=caches,
                                kv_chunk=kv_chunk)
        logits, caches = out[0], out[1]
        return logits[:, -1:], caches

    return prefill_step


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
