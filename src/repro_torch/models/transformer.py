"""Dense decoder-only transformer (llama / qwen / granite / mistral
families): the port of ``repro/models/transformer.py``.

GQA and MQA, qk-norm (qwen3), QKV bias (qwen2), sliding-window and
block-local attention masks, RoPE and a SwiGLU MLP.  The layers' parameters
are stacked on a leading layer axis, as the reference stacks them for its
``lax.scan``; :func:`forward` loops over that axis.  The reference's
``jax.checkpoint`` of the layer body only trades memory for recompute and
has no counterpart here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import tree as tree_lib
from repro_torch.models import layers as L
from repro_torch.models.params import stacked


def block_schema(cfg, *, shards: int = 16):
    return {
        "ln1": L.rmsnorm_schema(cfg.d_model),
        "attn": L.attention_schema(cfg, shards=shards),
        "ln2": L.rmsnorm_schema(cfg.d_model),
        "mlp": L.mlp_schema(cfg.d_model, cfg.d_ff),
    }


def schema(cfg, *, shards: int = 16):
    return {
        "embed": L.embedding_schema(cfg.padded_vocab, cfg.d_model,
                                    tie=cfg.tie_embeddings),
        "layers": stacked(block_schema(cfg, shards=shards), cfg.num_layers),
        "ln_f": L.rmsnorm_schema(cfg.d_model),
    }


def mask_spec(cfg) -> L.AttnMaskSpec:
    return L.AttnMaskSpec(
        causal=True, window=cfg.sliding_window, block_local=cfg.attention_chunk
    )


def transformer_block(p, x, cfg, *, mspec, positions, cache, kv_chunk):
    h, new_cache = L.attention_block(
        p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
        mask_spec=mspec, positions=positions, cache=cache, kv_chunk=kv_chunk,
    )
    x, normed = L.add_norm(x, h, p["ln2"], cfg.norm_eps)
    x = L.constrain(x, "residual")
    x = x + L.mlp_block(p["mlp"], normed)
    return L.constrain(x, "residual"), new_cache


def _per_layer(tree, n: int):
    """A tree of stacked (L, ...) leaves -> L trees of one layer each
    (``unbind``, so the backward pass stacks the layers' gradients once)."""
    leaves, treedef = tree_lib.tree_flatten(tree)
    split = [leaf.unbind(0) for leaf in leaves]
    return [tree_lib.tree_unflatten(treedef, [s[i] for s in split])
            for i in range(n)]


def forward(
    params,
    tokens: torch.Tensor,               # (B, S)
    cfg,
    *,
    caches: Optional[dict] = None,      # stacked per-layer cache tree
    positions: Optional[torch.Tensor] = None,
    kv_chunk: int = 1024,
):
    """Returns (logits (B, S, V) float32, new_caches)."""
    x = L.embed(params["embed"], tokens)
    mspec = mask_spec(cfg)
    n = cfg.num_layers
    if positions is None and caches is not None:
        positions = caches["len"][0] + torch.arange(
            tokens.shape[1], device=tokens.device)[None, :]
    layer_params = _per_layer(params["layers"], n)
    layer_caches = [None] * n if caches is None else _per_layer(caches, n)
    new_caches = []
    for p_layer, cache in zip(layer_params, layer_caches):
        x, new_cache = transformer_block(
            p_layer, x, cfg, mspec=mspec, positions=positions, cache=cache,
            kv_chunk=kv_chunk,
        )
        new_caches.append(new_cache)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x, tie=cfg.tie_embeddings)
    if caches is None:
        return logits, None
    return logits, tree_lib.tree_map(lambda *cs: torch.stack(cs), *new_caches)


def loss_fn(params, batch, cfg, **kw):
    logits, _ = forward(params, batch["tokens"], cfg, **kw)
    return L.cross_entropy(logits, batch["labels"], vocab_size=cfg.vocab_size)


def init_cache(cfg, batch: int, max_len: int, *, shards: int = 16,
               device=None):
    """Stacked (per-layer) KV cache for decode."""
    one = L.init_attn_cache(cfg, batch, max_len, shards=shards, device=device)
    return tree_lib.tree_map(
        lambda x: x[None].expand(cfg.num_layers, *x.shape).clone(), one
    )


def decode_step(params, caches, tokens, cfg, *, kv_chunk: int = 4096):
    """One-token decode: tokens (B, 1). Returns (logits (B, 1, V), caches)."""
    return forward(params, tokens, cfg, caches=caches, kv_chunk=kv_chunk)
